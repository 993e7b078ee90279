"""threefry2x32 random streams (the draws of `jax.random` that the engine
makes, bit for bit): `ref.py` in plain torch integer ops, `ops.py` the
wrappers that launch `csrc/threefry.cu` on the card."""
