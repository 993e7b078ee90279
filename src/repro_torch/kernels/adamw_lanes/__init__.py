"""The agents' clipped AdamW step, norm and update in one launch (see
csrc/adamw_lanes.cu): `ref.py` the plain torch version, `ops.py` the
wrapper."""
