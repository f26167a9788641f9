"""``paddle.incubate`` counterpart: the fused-op surface of the port."""
