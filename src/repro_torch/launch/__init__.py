"""The train step and the prefill/decode step wrappers on one device."""
