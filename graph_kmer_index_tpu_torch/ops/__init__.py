"""Device operations of the port: kernels K1 (ops.encode) and K2
(ops.lookup) with their plain PyTorch twins."""
