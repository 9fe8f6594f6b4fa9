"""Frame assembly of the port (``unclerenderer_tpu/render``)."""
