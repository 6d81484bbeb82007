"""The port's side of each channel kind (a traffic mix's ``channel.kind``):
``channels/<kind>.py`` holds ``schedule(spec, adj, seeds)`` → the port's
``ChannelSchedule`` over the base graph ``adj``; its reference side is
``reference/channels/<kind>.py``."""
