"""The parallel layer: device meshes over ``torch.distributed``, one
process per mesh device (parallel/mesh.py)."""
