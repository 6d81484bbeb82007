"""The port's side of each relay policy kind (a traffic mix's
``policy.kind``): ``policies/<kind>.py`` holds ``policy(spec)`` → the
port's relay policy; its reference side is ``reference/policies/<kind>.py``."""
