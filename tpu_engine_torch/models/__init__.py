"""Model configuration, parameters and forward pass of the port."""
