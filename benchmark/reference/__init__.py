"""Plain NumPy references of what the port's timed path computes, and the
comparisons that decide ``correct``. Nothing here imports torch, jax or
either package of the repository: the reference works every answer out
again from the generated bytes alone."""
