"""AIMM core (port of `repro.core`): the continual-learning dueling DQN agent."""
