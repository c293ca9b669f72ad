"""The plain reference: plain PyTorch and NumPy, independent of the port.

It imports neither the port (``libssa_tpu_torch``) nor JAX nor the JAX
package, and takes nothing the port made: it gets the benchmark's own
inputs (residue codes) and works every score out again.
"""
