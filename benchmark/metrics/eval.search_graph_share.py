"""eval.search_graph_share: the share of the frames the device search scanned
in the traced call (the program's counter ``search.frames``) that it ran as
replays of a captured CUDA graph (``search.graph_frames``), in %. A program
without the counter, or a search that scanned no frame, gives nothing."""


def read(run):
    try:
        from b2txt_tpu_torch.utils.profiling import counters
    except ImportError:
        return None
    c = counters()
    frames = c.get("search.frames", 0)
    if "search.graph_frames" not in c or not frames:
        return None
    return 100.0 * c["search.graph_frames"] / frames
