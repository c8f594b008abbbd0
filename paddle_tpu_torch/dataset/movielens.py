"""MovieLens-1M (counterpart of ``paddle_tpu/dataset/movielens.py``):
synthetic users and movies with latent-factor ratings.  A sample is
[user_id, gender_id, age_id, job_id, movie_id, category_ids, title_ids,
[rating]]."""
from __future__ import annotations

import numpy as np

from . import common

_N_USERS = 400
_N_MOVIES = 300
_N_CATEGORIES = 18
_TITLE_VOCAB = 500
_N_TRAIN = 6000
_N_TEST = 1000

age_table = [1, 18, 25, 35, 45, 50, 56]


class MovieInfo:
    def __init__(self, index, categories, title):
        self.index = int(index)
        self.categories = categories
        self.title = title


class UserInfo:
    def __init__(self, index, gender, age, job_id):
        self.index = int(index)
        self.is_male = gender == "M"
        self.age = age_table.index(int(age))
        self.job_id = int(job_id)


def _world():
    def gen():
        rng = np.random.RandomState(11)
        uf = rng.randn(_N_USERS, 6)
        mf = rng.randn(_N_MOVIES, 6)
        movies = []
        for _ in range(_N_MOVIES):
            cats = rng.choice(_N_CATEGORIES, size=rng.randint(1, 4),
                              replace=False).tolist()
            title = rng.randint(0, _TITLE_VOCAB,
                                size=rng.randint(2, 6)).tolist()
            movies.append((cats, title))
        users = []
        for _ in range(_N_USERS):
            users.append((int(rng.randint(0, 2)), int(rng.randint(0, 7)),
                          int(rng.randint(0, 21))))
        return uf, mf, movies, users
    return common.cached_synthetic("movielens", "world", gen)


def _ratings(n, seed):
    def gen():
        uf, mf, _, _ = _world()
        rng = np.random.RandomState(seed)
        rows = []
        for _ in range(n):
            u = rng.randint(0, _N_USERS)
            m = rng.randint(0, _N_MOVIES)
            score = float(np.dot(uf[u], mf[m]))
            rating = float(np.clip(np.round(3 + score / 3), 1, 5))
            rows.append((u, m, rating))
        return rows
    return common.cached_synthetic("movielens", f"ratings_{n}_{seed}", gen)


def _reader(n, seed):
    def reader():
        _, _, movies, users = _world()
        for u, m, rating in _ratings(n, seed):
            gender, age, job = users[u]
            cats, title = movies[m]
            yield [u, gender, age, job, m, cats, title, [rating]]
    return reader


def train():
    return _reader(_N_TRAIN, 0)


def test():
    return _reader(_N_TEST, 1)


def movie_info():
    _, _, movies, _ = _world()
    return {m: MovieInfo(m, cats, title)
            for m, (cats, title) in enumerate(movies)}


def user_info():
    _, _, _, users = _world()
    return {u: UserInfo(u, "M" if g else "F", age_table[a], j)
            for u, (g, a, j) in enumerate(users)}


def max_user_id():
    return _N_USERS


def max_movie_id():
    return _N_MOVIES


def max_job_id():
    return 20


def categories():
    return [f"cat{i}" for i in range(_N_CATEGORIES)]


def get_movie_title_dict():
    return {f"t{i}": i for i in range(_TITLE_VOCAB)}


def fetch():
    _world()
