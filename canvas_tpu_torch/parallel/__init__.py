"""More than one device: meshes of CUDA devices in one process, and the
BAM scan split over processes that share host data through
torch.distributed (gloo)."""
