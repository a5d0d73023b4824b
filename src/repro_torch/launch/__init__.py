"""Launchers of the port: the decomposition server
(:mod:`repro_torch.launch.serve`) and the language-model trainer
(:mod:`repro_torch.launch.train`)."""
