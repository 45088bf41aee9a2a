"""Image data model (the parts the layer commit needs)."""
