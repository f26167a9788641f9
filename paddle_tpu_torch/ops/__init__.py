"""Kernel wrappers of the port (``ops.cuda``)."""
