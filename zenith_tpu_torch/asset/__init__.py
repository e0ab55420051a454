"""Assets (torch port of zenith_tpu/asset): so far only the render-facing
vertex layout and mesh container (``render_types``). The glTF loader, the
asset manager, the registry and the DDS decoder wait until the cerberus
content is in the repository (ROADMAP item 11)."""
