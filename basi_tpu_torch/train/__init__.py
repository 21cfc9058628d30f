"""Single-device training (port of ``basi_tpu/train``)."""
