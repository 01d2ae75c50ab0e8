"""The benchmark's drivers of the program, one module per codec, found
by the ``codec`` key of a configuration. A driver runs the program's
Phase A on the cell's streams during set-up, builds the program's batch
entry, and dispatches batch k of the traffic (``dispatch``); it names
the span of its batch entry (``SPAN``) and the kernels that the
configuration's roofline metrics read (``KERNELS``)."""
