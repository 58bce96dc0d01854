from polympc_torch.control.nmpf import augment_ocp

__all__ = ["augment_ocp"]
