"""Virtual clusters: multi-tenant partitioning of one physical cluster
(ant-fork capability, ref: src/ray/gcs/gcs_virtual_cluster_manager.h:30,
gcs_virtual_cluster.h:154 — DivisibleCluster/IndivisibleCluster/
PrimaryCluster reduced to their scheduling-visible core).

Jobs bound to a virtual cluster schedule only on its nodes; unbound
jobs schedule on the unassigned remainder (the "primary cluster").
"""

from __future__ import annotations


def _gcs():
    from ant_ray_tpu_torch._private.worker import global_worker  # noqa: PLC0415

    global_worker._check_connected()
    return global_worker.runtime._gcs


def _to_node_ids(node_ids_hex):
    from ant_ray_tpu_torch._private.ids import NodeID  # noqa: PLC0415

    return [NodeID.from_hex(h) for h in node_ids_hex]


def create_virtual_cluster(vc_id: str, *, node_ids: list | None = None,
                           num_nodes: int | None = None,
                           divisible: bool = False) -> dict:
    """Carve a virtual cluster out of unassigned nodes: either the
    explicit hex ``node_ids`` or ``num_nodes`` picked from the free
    pool."""
    payload = {"vc_id": vc_id, "divisible": divisible,
               "num_nodes": num_nodes}
    if node_ids:
        payload["node_ids"] = _to_node_ids(node_ids)
    reply = _gcs().call("CreateVirtualCluster", payload, retries=3)
    if "error" in reply:
        raise ValueError(reply["error"])
    return reply


def remove_virtual_cluster(vc_id: str) -> bool:
    return _gcs().call("RemoveVirtualCluster", {"vc_id": vc_id},
                       retries=3)


def update_virtual_cluster(vc_id: str, *, add_nodes: list | None = None,
                           remove_nodes: list | None = None) -> dict:
    reply = _gcs().call("UpdateVirtualCluster", {
        "vc_id": vc_id,
        "add_nodes": _to_node_ids(add_nodes or []),
        "remove_nodes": _to_node_ids(remove_nodes or []),
    }, retries=3)
    if "error" in reply:
        raise ValueError(reply["error"])
    return reply


def list_virtual_clusters() -> dict:
    return _gcs().call("ListVirtualClusters", retries=3)


def bind_job(vc_id: str | None) -> None:
    """Bind the CURRENT job to a virtual cluster (None unbinds).  The
    reference assigns jobs at submission; rebinding mid-job affects
    tasks scheduled from now on."""
    from ant_ray_tpu_torch._private.worker import global_worker  # noqa: PLC0415

    runtime = global_worker.runtime
    reply = _gcs().call("SetJobVirtualCluster", {
        "job_id": runtime.job_id, "vc_id": vc_id}, retries=3)
    if isinstance(reply, dict) and "error" in reply:
        raise ValueError(reply["error"])
