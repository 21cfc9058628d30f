"""BASINet modules of the port (kernels mechanism, ResNet trunks)."""
