"""The share of the EVALUATION chunk loop's chunks replayed from a captured CUDA graph: the program's
``pipeline.replay`` regions over its ``pipeline.chunk`` regions, in percent. A program that replays no chunk
reads 0; one with no chunk region, nothing."""


def read(trace):
    chunks = trace.regions(r"pipeline\.chunk")
    if not chunks:
        return None
    return 100.0 * len(trace.regions(r"pipeline\.replay")) / len(chunks)
