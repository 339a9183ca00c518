"""repro_torch.launch — the production meshes and the dry run (port of
``repro/launch``). Importing it creates no process group."""
