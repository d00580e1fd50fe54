"""Hand-written Hopper kernels of the port (csrc/) and their wrappers."""
from .decode_step import fused_decode_step
from .quant import q4_matvec, q4_rmsnorm_matvec, q8_matvec, q8_rmsnorm_matvec, qmatmul, qnorm_matmul

__all__ = ["fused_decode_step", "q4_matvec", "q4_rmsnorm_matvec", "q8_matvec",
           "q8_rmsnorm_matvec", "qmatmul", "qnorm_matmul"]
