"""The model zoo (port of `repro.models`): the prefill forward and the
decode step of the dense-attention and Mamba2 archs."""
from repro_torch.models.model import Model, build_model  # noqa: F401
