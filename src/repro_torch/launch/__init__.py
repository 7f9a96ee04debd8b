"""Launch-side helpers of the port: the device mesh (:mod:`.mesh`) and
the serve launcher (:mod:`.serve`)."""
