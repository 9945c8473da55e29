"""The generation example on the port (``lm_generate``)."""
