"""See the module of the same name under ``repro`` for the reference."""
