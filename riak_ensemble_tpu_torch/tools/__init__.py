"""Operator tools of the port, run as ``python -m
riak_ensemble_tpu_torch.tools.<name>``."""
