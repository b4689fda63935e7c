"""The plain reference: PyTorch and NumPy only.

Nothing here imports the port or the JAX package, and nothing here takes a
weight, a table or a state that the port made. It recomputes, from the
benchmark's own inputs, what the timed path should have produced.
"""
