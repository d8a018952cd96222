"""Training of the port: the optimizer and the train state and steps."""
