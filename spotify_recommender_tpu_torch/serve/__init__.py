from spotify_recommender_tpu_torch.serve.server import RecommenderService, serve

__all__ = ["serve", "RecommenderService"]
