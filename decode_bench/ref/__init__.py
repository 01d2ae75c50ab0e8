"""The benchmark's plain reference: a frozen copy of the JAX package's
pure-Python H.264 and H.265 decoders (numpy only), with their imports
rewritten to this package and nothing else changed.

It decodes the benchmark's streams from their bytes, independently of
the program under test: no module here imports jax, the JAX package or
the PyTorch port, and nothing here reads what the port derived (plans,
packed buffers, pools). ``decode_bench/reference.py`` drives it.
"""
