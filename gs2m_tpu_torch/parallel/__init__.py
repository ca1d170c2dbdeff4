"""Scale-out: data-parallel training over torch.distributed (dp.py) and
band-sharded rendering and backward over a list of devices (sp.py)."""
