"""Host-side texture building: mip chains, combined material textures and pyramid atlases (numpy)."""
