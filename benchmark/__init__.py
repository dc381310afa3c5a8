"""The port's benchmark: one cell run once by ``benchmark/run.py``.

Nothing here imports JAX or the JAX package; the plain references under
``reference/`` import nothing of the port either.
"""
