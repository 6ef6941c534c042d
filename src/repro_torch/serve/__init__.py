"""Serving (port of ``repro.serve``): the batch ``generate`` API and its
``GenerateResult``.  The slot-pool ``ServeEngine`` belongs to a later slice
of the port."""
