"""Models of the port: ResNet-20/GN (the paper's §V model)."""
