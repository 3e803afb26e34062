"""Vectorized compute ops for the tiling core.

Host (numpy) reference implementations live beside their device (JAX/Pallas)
twins. The numpy versions define exact semantic parity with the reference
C++ (bit-identical float64 math); the device versions are used by the batch
pipeline on TPU and are validated against the numpy ones in tests.
"""
