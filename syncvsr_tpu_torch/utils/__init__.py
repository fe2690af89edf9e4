"""Device resolution, the flax <-> torch weight bridge and the kernel build."""
