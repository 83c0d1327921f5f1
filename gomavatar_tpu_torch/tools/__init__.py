"""The end-to-end demonstration chain of the port: the synthetic teacher
capture (``make_e2e_data``), the chain itself (``run_e2e``), the export of
the trained avatar (``export_trained``), the report (``make_e2e_report``)
and the learning check (``overfit_check``)."""
