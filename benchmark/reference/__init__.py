"""The plain reference of the benchmark: plain PyTorch and numpy, which
import nothing of the port, of the JAX package or of JAX."""
