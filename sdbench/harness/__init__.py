"""The benchmark's harness: traffic, the window, the trace, the work
counts and the check.  It imports the program (``ml_stable_diffusion_torch``)
only where it builds and drives the system under test."""
