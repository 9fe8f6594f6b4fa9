"""Host-side scene loading and assembly: glTF, scene JSON, camera,
procedural meshes and the flat scene records (numpy)."""
