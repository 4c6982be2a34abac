"""Long-lived entry points of the port: the coloring service
(``repro_torch.launch.coloring_service``) and the batched LM serving
driver (``repro_torch.launch.serve_lm``).  Nothing is imported here, so
``import repro_torch.launch`` stays light."""
