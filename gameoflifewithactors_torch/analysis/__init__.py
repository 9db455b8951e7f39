"""Runtime checks: the retrace budget (:mod:`.sanitizers`). The lint and
contract gates of the JAX package wait for ROADMAP A17."""
