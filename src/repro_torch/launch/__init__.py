"""Launch-side helpers of the port: the device mesh (:mod:`.mesh`), the
serve launcher (:mod:`.serve`) and the train launcher (:mod:`.train`)."""
