"""Launch steps of the port (counterpart of ``repro/launch``): the
production train, prefill and decode step functions (``steps``) and the
reference's hillclimbing cases on one card (``hillclimb``).  The
reference's TPU dry runs, HLO analysis and production mesh have no
counterpart on one card."""
