"""Host-side scene records and procedural meshes (numpy)."""
