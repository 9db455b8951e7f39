"""Batches and meshes. :mod:`.batched` steps a batch of independent
universes on one device (the serving lanes); :mod:`.mesh` places one grid
on a mesh of devices, :mod:`.halo` exchanges halos between its positions
and :mod:`.sharded` steps it, on full-width row bands through the slab
kernels or on 2D tiles in plain torch; :mod:`.multihost` spans a mesh
over the processes of one ``torch.distributed`` group."""
