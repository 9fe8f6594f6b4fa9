"""Host services of the renderer: logging, paths, the INI configuration, the
task pool, and the debug-print glyphs and host overlays (numpy)."""
