"""Multi-GPU runs on torch.distributed: the process mesh and the state's
block layout (mesh.py), the halo exchange (halo.py), the explicit-halo
hydro step (overlap.py) and the spawn helper (launch.py), as
``atmospheric_athena_tpu/parallel/``."""
