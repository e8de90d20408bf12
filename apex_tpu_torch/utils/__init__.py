"""Device resolution and the kernel build shared by the port's modules."""
