"""Host-side texture loading and building: PNG and DDS decoders, the
texture cache, mip chains, combined material textures and pyramid atlases
(numpy)."""
