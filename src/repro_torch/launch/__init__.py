"""Long-lived entry points of the port: the coloring service
(``repro_torch.launch.coloring_service``).  Nothing is imported here, so
``import repro_torch.launch`` stays light."""
