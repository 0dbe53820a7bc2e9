// CUDA graph conditional (if) nodes for a stream that is being captured:
// the device side of core/gates.py, for PyTorch builds whose CUDAGraph has
// no conditional-node API.
//
// graph_if_begin(outer, pred, negate, body) appends to the graph `outer`
// is capturing: a one-thread kernel that sets a conditional handle from
// the bool at `pred` (negated if `negate`), then an if node on that
// handle, and makes the node the capture's only dependency; it then starts
// capturing `body` into the node's body graph. graph_if_end(body) ends that
// capture. Nodes nest: `body` may itself be the outer stream of a node.
// graph_stream_create makes a non-blocking stream for bodies;
// graph_cond_load loads the kernel's module, which must not first happen
// inside a capture.
//
// Built with nvcc for sm_90a like the kernels (ops/build.py); every entry
// point returns a cudaError_t.

#include <cuda_runtime.h>

// CUDA 13 adds an edge-data argument to the capture-info, add-node and
// update-dependencies calls below
#if CUDART_VERSION >= 13000
#error "graph_cond.cu is written for the CUDA 12 runtime API"
#endif

__global__ void set_condition(cudaGraphConditionalHandle handle, const bool* pred, int negate) {
    cudaGraphSetConditional(handle, (*pred != 0) != (negate != 0) ? 1u : 0u);
}

extern "C" int graph_cond_load() {
    cudaFuncAttributes attr;
    return (int)cudaFuncGetAttributes(&attr, set_condition);
}

extern "C" int graph_stream_create(void** out) {
    cudaStream_t s;
    cudaError_t err = cudaStreamCreateWithFlags(&s, cudaStreamNonBlocking);
    *out = (void*)s;
    return (int)err;
}

extern "C" int graph_if_begin(void* outer_ptr, const bool* pred, int negate, void* body_ptr) {
    cudaStream_t outer = (cudaStream_t)outer_ptr, body = (cudaStream_t)body_ptr;
    cudaStreamCaptureStatus status;
    cudaGraph_t graph;
    const cudaGraphNode_t* deps;
    size_t n_deps;
    cudaError_t err = cudaStreamGetCaptureInfo(outer, &status, nullptr, &graph, &deps, &n_deps);
    if (err != cudaSuccess) return (int)err;
    if (status != cudaStreamCaptureStatusActive) return (int)cudaErrorStreamCaptureInvalidated;
    cudaGraphConditionalHandle handle;
    err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
    if (err != cudaSuccess) return (int)err;
    set_condition<<<1, 1, 0, outer>>>(handle, pred, negate);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    err = cudaStreamGetCaptureInfo(outer, &status, nullptr, &graph, &deps, &n_deps);  // now ending at the kernel
    if (err != cudaSuccess) return (int)err;
    cudaGraphNodeParams params = {};
    params.type = cudaGraphNodeTypeConditional;
    params.conditional.handle = handle;
    params.conditional.type = cudaGraphCondTypeIf;
    params.conditional.size = 1;
    cudaGraphNode_t node;
    err = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
    if (err != cudaSuccess) return (int)err;
    err = cudaStreamUpdateCaptureDependencies(outer, &node, 1, cudaStreamSetCaptureDependencies);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaStreamBeginCaptureToGraph(body, params.conditional.phGraph_out[0], nullptr, nullptr, 0,
                                              cudaStreamCaptureModeGlobal);
}

extern "C" int graph_if_end(void* body_ptr) {
    cudaGraph_t graph;
    return (int)cudaStreamEndCapture((cudaStream_t)body_ptr, &graph);
}
