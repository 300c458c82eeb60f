"""The plain reference that decides ``correct``: PyTorch and NumPy only.

Nothing here imports the program (``repro_torch``), its JAX original or
anything the program made; the harness hands these functions the points it
drew and the outputs the program returned, and the reference works out
again, in float64, what the program derived from the points.  ``tf32=True``
computes the same quantities with every product's operands rounded to
TF32, the control of the comparison.
"""
