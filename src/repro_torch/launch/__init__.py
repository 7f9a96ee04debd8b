"""Launch-side entry points of the port: the device mesh (:mod:`.mesh`), the
serve launcher (:mod:`.serve`), the train launcher (:mod:`.train`), and
the dry-run — every arch × shape × mesh cell placed by ``Rules`` and
priced for the H100 without allocating (:mod:`.dryrun`, its input specs
:mod:`.specs`), and the paper's technique itself on the production mesh
(:mod:`.dryrun_core`)."""
