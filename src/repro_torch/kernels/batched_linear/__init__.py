"""Batch-invariant products and sums of the agents' TD step (see
csrc/batched_linear.cu): `ref.py` the plain torch versions, `ops.py` the
wrappers and the linear layer built on them."""
