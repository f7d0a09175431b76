"""Multi-device decoding over a (channel, time) mesh of torch.distributed
ranks: ``distributed`` sets the process group and the mesh up, ``mesh``
decodes over it."""
