# Run nested sampling from R via reticulate.
#
# Setup:  install.packages("reticulate")
# Run:    Rscript runr_torch.r [--device cpu]   (default: the card)
#
# The likelihood is written in R and receives whole batches of points
# (vectorized=TRUE). Counterpart of the reference example
# languages/r/runr.r, on the PyTorch port (runr.r is the ultranest_tpu
# version). Untested: no R where the port is tested.

library(reticulate)

np = import("numpy")
un = import("ultranest_torch")

# the torch device, "cuda" unless `--device cpu` is given
args = commandArgs(trailingOnly=TRUE)
i = match("--device", args)
device = if (is.na(i)) "cuda" else args[i + 1]

paramnames = c("a", "b", "c")

mytransform <- function(params) {
  # scale the unit cube to (-1, 1)
  params * 2 - 1
}

mylikelihood <- function(params) {
  # gaussian at centers 0.1*(1..d), sigma 0.01
  centers = 0.1 * 1:length(paramnames)
  dim(centers) <- c(1, 3)
  L = -0.5 * apply((apply(params, 1, '-', centers) / 0.01)**2, MARGIN=2, sum)
  np$asarray(L)
}

sampler = un$ReactiveNestedSampler(paramnames, mylikelihood,
                                   transform=mytransform, vectorized=TRUE,
                                   device=device)
results = sampler$run()

# show samples:
pairs(results$samples, labels=paramnames)

# integral estimate:
print(paste("marginal likelihood estimate:", results$logz,
            " +- ", results$logzerr))
