"""Auxiliary subsystems. Counterpart of `parallelnbody_tpu/utils/`; only the
force-accuracy sampler is ported so far."""
