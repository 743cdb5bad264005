"""Traffic generators, one a kind of traffic. A traffic file names its generator under "generator"."""
