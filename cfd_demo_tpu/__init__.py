"""The package's former name, kept so existing imports still work.

Importing it returns cfd_demo_jax itself, and every cfd_demo_jax module
loaded by then is registered under this name too, so old submodule
imports resolve to the same module objects."""
import sys

import cfd_demo_jax

for _name, _module in list(sys.modules.items()):
    if _name.split(".")[0] == "cfd_demo_jax":
        sys.modules[__name__ + _name[len("cfd_demo_jax"):]] = _module
