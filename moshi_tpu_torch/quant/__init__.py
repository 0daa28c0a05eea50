"""Block-quantized weights and the matvec kernels that consume them."""
