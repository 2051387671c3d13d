from ieache.boot.bootstrap import (  # noqa: F401
    DeviceCloudKey,
    pack_cloud_key,
)
from ieache.boot import gates  # noqa: F401

# NOTE: the `bootstrap`/`bootstrap_no_ks` functions live in
# ieache.boot.bootstrap; they are intentionally not re-exported here
# so that `ieache.boot.bootstrap` keeps naming the submodule.
