from detr_tpu_torch.viz.visualize import plot, plot_grid, render_bounding_boxes

__all__ = ["plot", "plot_grid", "render_bounding_boxes"]
