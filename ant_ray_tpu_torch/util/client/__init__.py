"""Remote client proxy — connect to a cluster from outside it.

The analogue of Ray Client (ref: python/ray/util/client/): a driver-side
proxy server runs next to the cluster, and remote processes connect with
``art.init("art://host:port")``.  The client process runs no daemons and
holds no object store; every API call is proxied over the RPC substrate
to the server, which executes it against a real in-cluster driver
runtime and pins results until the client releases them.
"""

from ant_ray_tpu_torch.util.client.runtime import ClientRuntime
from ant_ray_tpu_torch.util.client.server import ClientServer, start_client_server

__all__ = ["ClientRuntime", "ClientServer", "start_client_server"]
