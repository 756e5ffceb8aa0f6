# Run nested sampling from Julia via PyCall.
#
# Setup:  julia -e 'using Pkg; Pkg.add("PyCall")'
# Run:    julia runjl_torch.jl [--device cpu]   (default: the card)
#
# The likelihood is written in Julia and receives whole batches of points
# (vectorized=true), so the sampler's batched candidate pipeline feeds it
# (npoints, ndim) matrices. Counterpart of the reference example
# languages/julia/runjl.jl, on the PyTorch port (runjl.jl is the
# ultranest_tpu version). Untested: no Julia where the port is tested.

using PyCall

np = pyimport("numpy")
ultranest = pyimport("ultranest_torch")

# the torch device, "cuda" unless `--device cpu` is given
i = findfirst(==("--device"), ARGS)
DEVICE = i === nothing ? "cuda" : ARGS[i + 1]

function mytransform(cube)
    # scale the unit cube to (-1, 1)
    cube * 2 .- 1
end

function mylikelihood(params)
    # gaussian at centers (0.0, 0.1, 0.2), sigma 0.01
    n, d = size(params)
    centers = 0.1 * reshape(np.arange(d), (1, d))
    -0.5 * dropdims(sum(((params .- centers) / 0.01) .^ 2, dims=2), dims=2)
end

paramnames = ["a", "b", "c"]
sampler = ultranest.ReactiveNestedSampler(
    paramnames, mylikelihood, transform=mytransform, vectorized=true,
    device=DEVICE)
results = sampler.run()
print("result has these keys:", keys(results), "\n")

sampler.print_results()
sampler.plot()
