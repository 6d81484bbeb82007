"""The relay kernels: hand-written CUDA for Hopper (``csrc/``), their plain
torch versions (``ref``), and the backend dispatch (``ops``)."""
