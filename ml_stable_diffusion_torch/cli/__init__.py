"""The port's command line: ``generate``, ``convert``, ``benchmark`` and
``compress`` (``python -m ml_stable_diffusion_torch.cli.<name>``, or the
``sdtorch-<name>`` scripts), flag for flag the JAX package's commands."""
