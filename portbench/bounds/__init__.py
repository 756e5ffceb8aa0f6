"""One module a hand kernel of ``ultranest_torch.ops.kernels``: ``ENTRY``
(the wrapper's name), ``KERNELS`` (its device kernels' names), ``ONCE``
(those of them of which exactly one runs once a call),
``record(args, out, captured)`` (what the call leaves to work its bound
out from, with no work on the device inside the window) and
``bound_s(rec)`` (the bound in seconds, or None), called once the window
has closed."""
