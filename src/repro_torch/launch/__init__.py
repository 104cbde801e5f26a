"""Launchers of the port (counterpart of ``repro.launch``): the serving
engine, the step builders and their spec functions, the training loop,
the mesh factories and the dry run (``launch.dryrun``, on the meta
device)."""
