"""nn.Modules of the port (NCHW internals, reference mmseg parameter names)."""
