"""Launchers of the port: ``python -m repro_torch.launch.serve`` and
``python -m repro_torch.launch.train``, the steps they run, and the
dry-run launchers (``launch.dryrun``, ``launch.engine_dryrun``) with
their meshes, input specs and roofline counter."""
