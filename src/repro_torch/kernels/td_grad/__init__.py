"""The agents' TD step, forward, loss and backward of the dueling Q network
in one launch (see csrc/td_grad.cu): `ref.py` the plain torch version,
`ops.py` the wrapper and the shapes the kernel covers."""
