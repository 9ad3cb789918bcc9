"""Command-line entry points (``python -m multimodal_isic_tpu_torch.cli.<name>
--config_path config.yml``)."""
