"""The multi-device engine's communication layer (twin of
``repro.distributed``): the fixed-capacity feature all-to-all and the
compressed gradient all-reduce, over a ``launch.mesh.Mesh``."""
