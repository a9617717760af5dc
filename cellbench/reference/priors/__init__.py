"""Tape priors of the reference, one module each, named by a configuration
file's `"reference_prior"`: `tape_prior(built, cfg)` → None when the
configuration asks for no prior (`mppi.use_priors` off), else a function
`(state, t0) → (H, nu)` of the 1-env world state and the world's control
step clock."""
