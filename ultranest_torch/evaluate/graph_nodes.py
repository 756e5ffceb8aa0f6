"""The kernel nodes of a call captured in a CUDA graph, by name.

What a round or a step of a population walk launches, read from the
graph itself: ``chip_smoke.py`` prints it for the real sync and
random-walk dispatches and ``tests/test_torch_cuda.py`` holds it. A
measurement helper; nothing in the samplers calls it.

The graph is read through the CUDA driver (``libcuda``, by ctypes):
``cuGraphGetNodes``, ``cuGraphNodeGetType`` and
``cuGraphKernelNodeGetParams_v2``, whose ``CUDA_KERNEL_NODE_PARAMS_v2``
holds the ``CUfunction`` at byte 0 and the ``CUkernel`` at byte 56
(``cuda.h`` of CUDA 12), then ``cuFuncGetName`` or ``cuKernelGetName``.
Needs a CUDA device.
"""

import ctypes

import torch

__all__ = ['graph_kernel_names']


def graph_kernel_names(fn, device):
    """The kernel nodes of one call of *fn* captured in a CUDA graph, in
    the graph's order, each by its function's (mangled) name; a node of
    another kind as ``<node type N>`` (N a ``CUgraphNodeType``)."""
    g = torch.cuda.CUDAGraph(keep_graph=True)
    cur = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device=device)
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        g.capture_begin()
        try:
            fn()
        finally:
            g.capture_end()
    cur.wait_stream(side)
    cu = ctypes.CDLL('libcuda.so.1')
    vp = ctypes.c_void_p

    def check(rc, what):
        if rc != 0:
            raise RuntimeError('%s failed: CUresult %d' % (what, rc))
    graph = vp(g.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    check(cu.cuGraphGetNodes(graph, None, ctypes.byref(n)), 'cuGraphGetNodes')
    nodes = (vp * n.value)()
    check(cu.cuGraphGetNodes(graph, nodes, ctypes.byref(n)), 'cuGraphGetNodes')
    names = []
    for node in nodes:
        kind = ctypes.c_int()
        check(cu.cuGraphNodeGetType(vp(node), ctypes.byref(kind)),
              'cuGraphNodeGetType')
        if kind.value != 0:             # CU_GRAPH_NODE_TYPE_KERNEL
            names.append('<node type %d>' % kind.value)
            continue
        # CUDA_KERNEL_NODE_PARAMS_v2: func at byte 0, kern at byte 56
        params = (ctypes.c_char * 128)()
        check(cu.cuGraphKernelNodeGetParams_v2(vp(node), params),
              'cuGraphKernelNodeGetParams')
        func = vp.from_buffer(params, 0).value
        kern = vp.from_buffer(params, 56).value
        name = ctypes.c_char_p()
        if func:
            check(cu.cuFuncGetName(ctypes.byref(name), vp(func)),
                  'cuFuncGetName')
        else:
            check(cu.cuKernelGetName(ctypes.byref(name), vp(kern)),
                  'cuKernelGetName')
        names.append(name.value.decode())
    return names
