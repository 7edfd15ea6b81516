"""Native (C++) components: the double-precision direct-sum oracle, the
ground truth of the energy-drift gates. Counterpart of
`parallelnbody_tpu/native/`, built by g++ at first use and bound by ctypes
(native/oracle.py)."""

from parallelnbody_tpu_torch.native.oracle import Oracle, build_oracle_lib

__all__ = ["Oracle", "build_oracle_lib"]
