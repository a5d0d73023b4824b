"""Launchers of the port: the decomposition server
(:mod:`repro_torch.launch.serve`)."""
