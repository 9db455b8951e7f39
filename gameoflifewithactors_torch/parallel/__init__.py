"""Batch-of-universes runners on one device: the batch is a leading tensor
dimension (:mod:`.batched`), with the one-device row-halo exchange of
:mod:`.halo`. Multi-device meshes are not ported yet (ROADMAP A12)."""
