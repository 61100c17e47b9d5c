"""The dense causal LM (``model``) and its layers (``layers``)."""
