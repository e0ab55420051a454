"""Demo apps (reference zenith-sandbox; torch port of zenith_tpu/sandbox)."""
