"""The likelihoods and transforms a user hands the sampler, one module a
problem: ``make(device, **problem_args)`` returns the sampler's inputs."""
