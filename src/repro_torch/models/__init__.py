"""Model zoo of the port: the dense, MoE and VLM decoders, RWKV-6, Hymba
and Whisper (see :mod:`repro_torch.models.api`)."""
