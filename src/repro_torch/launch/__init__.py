"""The continuous-training service: the burst-wise trainer (``train``) and
the snapshot-watching eval loop (``serve``)."""
