"""Fused dueling-DQN inference kernel (port of `repro.kernels.dueling_qnet`)."""
