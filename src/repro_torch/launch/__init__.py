"""Launchers of the port (counterpart of ``repro.launch``): the serving
engine, the step builders and the training loop."""
