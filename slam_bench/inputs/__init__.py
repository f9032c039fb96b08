"""The benchmark's inputs, made on the device from the seed."""
