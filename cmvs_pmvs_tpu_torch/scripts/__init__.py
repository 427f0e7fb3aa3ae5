"""Measurement entry points of the port, run on the GPU with
`python -m cmvs_pmvs_tpu_torch.scripts.<name>`."""
