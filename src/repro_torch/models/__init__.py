"""Model zoo of the port: the dense and MoE decoder families (see
:mod:`repro_torch.models.api`)."""
