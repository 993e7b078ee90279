"""Entry points of the model zoo (port of `repro.launch`)."""
