"""scroll.host_syncs_per_node: host synchronisations a node, counted by
torch.cuda.set_sync_debug_mode("warn") over the window's node steps, the
harness's own left out."""

UNIT = "syncs/node"
LAYER = "coeval scroll"
MOVES = "lightcone_s"


def read(record):
    n = record["nodes"]
    return None if not n else record["node_host_syncs"] / n
